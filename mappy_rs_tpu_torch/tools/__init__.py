"""Tools of the port: the genome-scale run (gbp_chip) and the device
index budget (hbm_budget)."""
