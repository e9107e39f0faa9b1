"""Training runtime of the port (``repro.runtime``): the DDP step
(``ddp``) and the fault-tolerant loop (``trainer``)."""
