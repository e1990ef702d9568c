"""The paper's own workload configs (AIA chip benchmarks, Fig. 7).

Selectable via ``--config aia-mrf-penguin`` etc. in
``repro_torch/launch/run_mcmc.py``.  A plain copy of the reference's
``repro.configs.aia_paper``: same names, sizes and knobs, plus
``bn-munin-scale``, the port's own (a net at Munin's published counts,
``pgm/networks.py::munin_scale``; 1,024 chains).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MCMCConfig:
    name: str
    kind: str              # "mrf" | "bayesnet"
    # mrf
    height: int = 0
    width: int = 0
    n_labels: int = 0
    beta: float = 2.0
    tau: int = 4
    pairwise: str = "potts"     # potts | truncated_linear
    # bayesnet
    network: str = ""           # asia | sprinkler | child_scale | ...
    # common
    n_chains: int = 16
    n_sweeps: int = 1000
    burn_in: int = 200
    k: int = 14                 # fixed-point weight precision
    use_iu: bool = True


PENGUIN = MCMCConfig(
    name="aia-mrf-penguin", kind="mrf", height=500, width=333, n_labels=2,
    beta=2.0, pairwise="potts")

ART = MCMCConfig(
    name="aia-mrf-art", kind="mrf", height=288, width=384, n_labels=16,
    beta=1.0, tau=4, pairwise="truncated_linear")

BAYESNETS = {
    "aia-bn-asia": MCMCConfig(name="aia-bn-asia", kind="bayesnet",
                              network="asia", n_chains=256),
    "aia-bn-child": MCMCConfig(name="aia-bn-child", kind="bayesnet",
                               network="child_scale", n_chains=256),
    "aia-bn-alarm": MCMCConfig(name="aia-bn-alarm", kind="bayesnet",
                               network="alarm_scale", n_chains=256),
    "aia-bn-hailfinder": MCMCConfig(name="aia-bn-hailfinder", kind="bayesnet",
                                    network="hailfinder_scale", n_chains=128),
    "bn-munin-scale": MCMCConfig(name="bn-munin-scale", kind="bayesnet",
                                 network="munin_scale", n_chains=1024),
}

MCMC_CONFIGS = {PENGUIN.name: PENGUIN, ART.name: ART, **BAYESNETS}
