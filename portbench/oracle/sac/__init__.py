"""A frozen plain SAC update: the one piece of the reference copied from the program."""
