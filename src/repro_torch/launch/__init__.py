"""Launchers of the port: the MCMC driver."""
