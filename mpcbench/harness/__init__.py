"""The harness: finds a cell's files, builds the program's tick, runs the
window or the traced stretch, and checks the result against the
reference."""
