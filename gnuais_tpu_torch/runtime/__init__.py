"""Runtime: the decode step with its carry, the host frame drain, the
single-channel receiver and the many-stream batch session."""
