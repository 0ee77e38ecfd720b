"""The worker side of the operator's injection contract."""
