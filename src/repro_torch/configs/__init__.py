"""Config package: the dense model configs of the serving path + registry."""
