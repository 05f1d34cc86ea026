"""Virtual-time discrete-event simulation of the RDMA lock stack.

``SimEngine`` runs cooperative generator tasks against a ``VirtualClock``
with a seeded, fully deterministic scheduler; ``SimFabricMemory`` prices
every register operation as a virtual-time charge (local op, doorbell, work
request); ``run_lock_table_sim`` drives the sharded lock table with
home/uniform/zipfian/failover client fleets at scales (64 hosts × 16
clients, 10⁵ ops) the thread-per-client benchmark cannot reach — producing
exact, byte-identical per-class operation counts per seed.

See ``docs/simulation.md`` for the execution model and how to write a
workload.
"""

from .engine import SimEngine, SimLivelockError, VirtualClock  # noqa: F401
from .fabric import FabricFaults, FabricLatency, SimFabricMemory  # noqa: F401
from .workloads import SIM_WORKLOADS, SimResult, run_lock_table_sim  # noqa: F401
