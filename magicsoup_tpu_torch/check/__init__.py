"""State invariants computed on the device by the pipelined step."""
