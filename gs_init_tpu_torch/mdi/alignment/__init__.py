"""Depth alignment: least squares, RANSAC/MSAC, interpolated scale maps."""
