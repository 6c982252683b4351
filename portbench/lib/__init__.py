"""What every cell shares: files by name, clocks and spans, trace, counts, weights, inputs."""
