"""Host-side utilities of the port: PLY and compressed-splat IO, memory stats, TensorBoard event files."""
