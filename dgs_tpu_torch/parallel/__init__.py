"""Sharded execution over a ("data", "model") mesh of ranks
(``torch.distributed``): see ``mesh``."""
