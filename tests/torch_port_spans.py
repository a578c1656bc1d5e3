"""The span names the port records and the JAX package does not, for the
tests that hold the port's traces to the JAX package's: the serving
loop's two waits, a launch's last two legs and the executor's merge."""

PORT_ONLY = frozenset({"loop.lock-wait", "loop.idle", "dispatch-wait",
                       "launch-run", "merge"})
