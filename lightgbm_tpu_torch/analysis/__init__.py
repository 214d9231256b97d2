"""Program contracts of the port: the memory-budget registry
(``contracts.py``).  The reference's trace lint (collective and donation
contracts, the jaxpr walkers) is ROADMAP queue 1 item 12."""
