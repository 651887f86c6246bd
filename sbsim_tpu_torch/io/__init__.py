"""Training I/O: JSONL metrics and checkpoints (port of sbsim_tpu/io)."""
