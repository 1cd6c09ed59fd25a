"""Spinnaker core: the paper's Paxos replication protocol, log/storage
engine, coordination service, and cluster — on a deterministic simulator.
"""

from .cluster import Client, ClusterConfig, SpinnakerCluster, key_of
from .coordination import Coordination
from .node import NodeConfig
from .ranges import BalancerConfig, RangeBalancer, RangeTable
from .replica import ReplicaConfig, Role
from .sim import DiskParams, NetParams, Simulator
from .types import ErrorCode, OpType, Result, WriteOp

__all__ = [
    "BalancerConfig", "Client", "ClusterConfig", "SpinnakerCluster",
    "key_of", "Coordination", "NodeConfig", "RangeBalancer", "RangeTable",
    "ReplicaConfig", "Role", "DiskParams", "NetParams", "Simulator",
    "ErrorCode", "OpType", "Result", "WriteOp",
]
