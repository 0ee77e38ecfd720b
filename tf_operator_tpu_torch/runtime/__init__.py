"""Training-run plumbing shared by the port's entry points."""
