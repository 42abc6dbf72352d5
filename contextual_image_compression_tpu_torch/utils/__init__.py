"""Helpers over parameter trees: modules, state dicts and numpy trees."""
