from repro_torch.checkpoint.manifest import RunManifest, atomic_write_json
from repro_torch.checkpoint.replication_store import (
    DiskLayerTier,
    DurableLayerReplicaStore,
    LayerReplicaStore,
    ReplicatedCheckpointer,
)
