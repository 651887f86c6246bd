"""I/O: JSONL metrics, checkpoints and proto record shards (port of
sbsim_tpu/io)."""
