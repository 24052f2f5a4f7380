"""Runtime utilities: config, checkpointing, benchmark rows, system info."""
