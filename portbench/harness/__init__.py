"""The harness's general parts: finding a cell's files, making its
traffic, reducing its timings and its device trace."""
