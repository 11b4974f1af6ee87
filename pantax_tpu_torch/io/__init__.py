"""Host layer (io), the port's copy of pantax_tpu/io (numpy only)."""
