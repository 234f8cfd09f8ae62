"""Datasets of the port (numpy only): the paper's mass-spring-damper workload and synthetic LM and GP data."""
