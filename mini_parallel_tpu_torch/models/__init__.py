"""Workload pipelines: the alignment engine and the --full-wgs driver."""
