"""The plain reference that decides `correct`: the building, its clock,
the FDM solve, the HVAC devices and the 3C reward worked out again from the
configuration file alone, in float64 PyTorch or NumPy. It imports nothing
of the program, of JAX or of the JAX package. `sac/` is the one piece
copied from the program: a frozen plain SAC update."""
