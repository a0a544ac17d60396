"""The cluster simulator (copy of `repro.cluster`, the same exports)."""
from repro_torch.cluster.registry import ClusterState, ClusterTopology, Device  # noqa: F401
from repro_torch.cluster.workload import WorkloadGen  # noqa: F401
from repro_torch.cluster.simulator import TrainingSim, SimConfig  # noqa: F401
from repro_torch.cluster.events import Event, EventTrace, apply_event  # noqa: F401
from repro_torch.cluster import scenarios  # noqa: F401
