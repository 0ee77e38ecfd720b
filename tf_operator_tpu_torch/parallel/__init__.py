"""Training on one device: the trainer and the serving export."""
