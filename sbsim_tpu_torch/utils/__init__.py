"""Host-side helpers: time/unit/id conversions and telemetry (ports of
sbsim_tpu/utils on `datetime` and numpy)."""
