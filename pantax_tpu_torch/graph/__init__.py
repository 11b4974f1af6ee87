"""Host layer (graph), the port's copy of pantax_tpu/graph (numpy only)."""
