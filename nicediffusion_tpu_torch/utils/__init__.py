"""Presets, weight conversion and checkpoint loading."""
