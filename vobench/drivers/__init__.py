"""Traffic drivers, one module per kind of traffic, named by a mix's
`driver`: each has `setup(run)`, `window(run, state)`, `sample(run, state,
result)` and `reference(run, args)`."""
