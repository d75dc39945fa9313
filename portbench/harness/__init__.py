"""The harness: loading the cell's files, the measured window, the trace's
reduction and the result line."""
