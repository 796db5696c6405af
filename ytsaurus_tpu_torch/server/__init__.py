"""The port's server-side agents that run inside the one-process
cluster: the queue agent and the view daemon."""
