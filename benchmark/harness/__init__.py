"""The benchmark's harness: set-up, the measured window and the result line."""
