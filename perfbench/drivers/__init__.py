"""One module per kind of traffic, found by the mix's "driver" name; each
has `run(cell) -> harness.Outcome`."""
