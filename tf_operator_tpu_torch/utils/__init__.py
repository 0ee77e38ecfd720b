"""The serving plane's records: metrics and the dispatch ledger,
traces, structured logs, the flight recorder and the alert engine
(copies of the JAX package's ``utils`` modules of the same names)."""
