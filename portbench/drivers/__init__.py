"""The general generator of each traffic kind (a mix's `kind`): `run(cell,
seed=, seconds=, trace=, t_start=)` returns a harness.Outcome."""
