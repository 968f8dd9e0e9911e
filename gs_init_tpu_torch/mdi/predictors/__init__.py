"""Depth predictors. The port has the stub predictor; the depth networks
come with their weights (a later slice)."""
