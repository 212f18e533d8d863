"""Launchers: the serve entry point and the shared corpus helpers."""
