"""The harness: cells, weights, inputs, the timed window, the trace, the check."""
