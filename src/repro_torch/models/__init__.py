"""Model assembly and layers (main-path subset)."""
