"""nm.launches_per_restart: kernel launches the host made (the runtime's
launch calls in the trace) per restart of the profiled pools, with the
arithmetic of metrics/zoo.launches_per_restart.py.  Layer: models/base.run
and the models/nmplus round loop (``_nm_while_batched``), whose torch
operations are launched one by one, a round at a time.  Moves
zoo_restarts_per_s."""

from robchar_bench import harness

read = harness.reader("zoo.launches_per_restart")
