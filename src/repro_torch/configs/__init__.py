"""Architecture configurations of the LM workloads: one ``ArchConfig`` per
LM architecture, registered by name."""
