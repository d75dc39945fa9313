"""Traffic kinds: one module per kind, found by the name a workload file
gives (``traffic/<kind>.py``), each with a ``Session`` class."""
