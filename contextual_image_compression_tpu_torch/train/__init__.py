"""GAN training of the adaptive codec: losses, keras-style Adam, the fused
train step and the epoch loop."""
