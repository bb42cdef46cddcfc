"""The plain reference: the scene files read, trees built and frames
rendered again in plain torch, with nothing of the program imported."""
