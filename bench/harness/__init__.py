"""The benchmark harness of the port: spec, requests, checks, traces."""
