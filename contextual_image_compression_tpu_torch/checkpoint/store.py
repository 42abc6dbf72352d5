"""Component-addressable checkpoint store.

Counterpart of `contextual_image_compression_tpu/checkpoint/store.py`, with
the same files and semantics:

  * each component is its own `{name}_{tag}.msgpack` in flax's msgpack
    format (checkpoint/flax_msgpack.py), written to a `.tmp` file and
    renamed over the target, so a writer that dies never truncates a good
    file; `metadata_{tag}.json` goes through the same temp file;
  * save points are tagged `epoch_N` and `final`;
  * loading falls down the ladder prefer_tag -> the latest readable
    `epoch_N` -> the template (fresh init), per component, and records the
    provenance `final` (the prefer_tag), `epoch_N` or `init`; a file that
    fails to parse or to match the template prints why and falls through.

The store deals in trees of JAX's layout (dicts of numpy arrays; torch
tensors are written as arrays too). `convert.py` maps them to and from the
port's modules.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from contextual_image_compression_tpu_torch.checkpoint import flax_msgpack

_EPOCH_RE = re.compile(r"^(?P<name>.+)_epoch_(?P<epoch>\d+)\.msgpack$")


def restore(template: Any, state: Any) -> Any:
    """What flax.serialization.from_state_dict does with a tree of dicts: the
    state's values in the template's structure and key order. A key of the
    template missing from the state raises ValueError; keys only the state
    has are dropped; leaves are taken as they are, shapes unchecked (a
    leaf of the wrong shape fails where convert.py loads it into a module:
    `load_state_dict` reports the size mismatch)."""
    if not isinstance(template, dict):
        return state
    if not isinstance(state, dict):
        raise ValueError(f"the template holds a dict where the file holds {type(state).__name__}")
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(f"the file lacks keys {sorted(missing)} of the template")
    return {k: restore(v, state[str(k)]) for k, v in template.items()}


class CheckpointStore:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ paths
    def _path(self, name: str, tag: str) -> str:
        return os.path.join(self.directory, f"{name}_{tag}.msgpack")

    def available_epochs(self, name: str = "hq_encoder") -> List[int]:
        """The epochs saved for a component, in ascending order."""
        if not os.path.isdir(self.directory):
            return []
        epochs = []
        for f in os.listdir(self.directory):
            m = _EPOCH_RE.match(f)
            if m and m.group("name") == name:
                epochs.append(int(m.group("epoch")))
        return sorted(epochs)

    # ------------------------------------------------------------------- save
    def save_component(self, name: str, tree: Any, tag: str) -> str:
        """Write the tree to a temp file, then rename it over the target."""
        path = self._path(name, tag)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            flax_msgpack.write(f, tree)
        os.replace(tmp, path)
        return path

    def save_components(self, components: Dict[str, Any], tag: str) -> None:
        for name, tree in components.items():
            self.save_component(name, tree, tag)

    def save_metadata(self, meta: Dict[str, Any], tag: str) -> None:
        path = os.path.join(self.directory, f"metadata_{tag}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(path + ".tmp", path)

    # ------------------------------------------------------------------- load
    def load_component(self, name: str, template: Any, tag: str) -> Any:
        """The file's tree restored into the template (see `restore`)."""
        return restore(template, flax_msgpack.read(self._path(name, tag)))

    def has(self, name: str, tag: str) -> bool:
        return os.path.exists(self._path(name, tag))

    def load_components(
        self, templates: Dict[str, Any], prefer_tag: str = "final"
    ) -> Tuple[Dict[str, Any], Dict[str, str]]:
        """Each component by the ladder prefer_tag -> latest epoch -> template.
        Returns (components, provenance), provenance[name] being prefer_tag,
        'epoch_N' or 'init'."""
        out: Dict[str, Any] = {}
        provenance: Dict[str, str] = {}
        for name, template in templates.items():
            if self.has(name, prefer_tag):
                try:
                    out[name] = self.load_component(name, template, prefer_tag)
                    provenance[name] = prefer_tag
                    continue
                except Exception as e:  # a corrupt file falls through to the scan
                    print(f"Failed to load {name} at {prefer_tag}: {e}")
            loaded = False
            for epoch in reversed(self.available_epochs(name)):
                tag = f"epoch_{epoch}"
                try:
                    out[name] = self.load_component(name, template, tag)
                    provenance[name] = tag
                    loaded = True
                    break
                except Exception as e:  # a corrupt file: keep scanning back
                    print(f"Failed to load {name} at {tag}: {e}")
            if not loaded:
                out[name] = template
                provenance[name] = "init"
        return out, provenance

    def load_metadata(self, tag: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.directory, f"metadata_{tag}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_metadata(self) -> Optional[Dict[str, Any]]:
        """metadata_final, else that of the latest epoch, else None."""
        if (m := self.load_metadata("final")) is not None:
            return m
        epochs = sorted(
            int(f.split("_epoch_")[1].split(".json")[0])
            for f in os.listdir(self.directory)
            if f.startswith("metadata_epoch_") and f.endswith(".json")
        )
        if epochs:
            return self.load_metadata(f"epoch_{epochs[-1]}")
        return None
