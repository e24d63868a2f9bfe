"""Tools of the port: the genome-scale run (gbp_chip), the device index
budget (hbm_budget), the concordance sweep of the two front ends
(concordance) and the front-end trace with the host's stage breakdown
(trace_front_end)."""
