"""The harness: cells, weights, timing, traces, checks and the result line."""
