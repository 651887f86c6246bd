"""SAC agents: networks, replay, learner, exploration, schedule baseline,
trainer and policy export (port of sbsim_tpu/agents)."""
