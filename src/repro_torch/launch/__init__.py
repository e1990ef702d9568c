"""Launchers of the port: the MCMC driver, the serving launcher and the
trainer."""
