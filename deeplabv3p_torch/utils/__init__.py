"""numpy-only helpers (class lists, visualization, weight bridge)."""
