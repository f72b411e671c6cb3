"""FTPipeHD's algorithmic core (paper §III): dynamic partition DP, capacity
estimation, 1F1B schedule semantics, weight stashing/aggregation, replication
policy, weight redistribution (Algorithm 1), and the fault-tolerance state
machine. Everything here is pure logic — runnable both by the edge simulator
and by the TPU launcher."""
