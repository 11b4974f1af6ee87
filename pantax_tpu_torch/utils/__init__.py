"""Host layer (utils), the port's copy of pantax_tpu/utils (numpy only)."""
