"""Datasets of the port: the paper's mass-spring-damper workload (numpy only)."""
