"""Optimizers and the train, prefill and serve steps; mirrors
`repro.train`."""
