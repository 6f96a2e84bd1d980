"""Multi-rank training support: the device mesh over a process group
(``mesh``), the logical-axis rules and the sequence-parallel helpers
(``sharding``)."""
