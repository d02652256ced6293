"""Config package: the model configs of every family the port serves, the
APC deployments and the registry."""
