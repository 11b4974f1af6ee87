"""Host layer (db), the port's copy of pantax_tpu/db (numpy only)."""
