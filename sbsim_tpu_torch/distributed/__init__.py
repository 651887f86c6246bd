"""Ranks over the env axis on torch.distributed (port of
sbsim_tpu/distributed): `runtime` brings up the process group and holds
its collectives, `mesh` shards the training state and runs the trainer's
step on each rank's rows."""
