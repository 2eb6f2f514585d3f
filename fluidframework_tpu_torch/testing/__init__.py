"""Workloads for the port: the pinned synthetic catch-up corpora (the
library entries' and the catch-up service's), the hard-semantics
fixtures, and the fault injector the op log reads."""
