"""Stand-alone probes of the port."""
