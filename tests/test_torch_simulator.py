"""The port's policy simulator (paper Fig. 9/10) against the JAX
package's, given v5e's constants (the JAX simulator reads them
implicitly; the port's default is the H100's).

Requests are drawn from a seed with numpy: Poisson arrivals and prompts
from 1K to 300K tokens, so that under "infinite" the long ones spill
and stripe over creditors. For the three policies, with striping on and
off, the ``run`` dicts and every request's ``finish_time``, ``failed``
and ``spans`` must be equal; the oversized-request case of
``tests/test_roofline_sim.py`` holds in both packages.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.distributed.hardware import V5E
from repro.serving import simulator as jsim
from repro.serving.perfmodel import InstancePerfModel as JaxPerf
from repro_torch.configs import get_config
from repro_torch.distributed.hardware import H100, HardwareSpec
from repro_torch.serving import simulator as psim

ARCH = "mistral-nemo-12b"


def _v5e() -> HardwareSpec:
    fields = {f.name for f in dataclasses.fields(HardwareSpec)}
    return HardwareSpec(**{k: v for k, v in dataclasses.asdict(V5E).items()
                           if k in fields})


def _requests(pkg, seed=0, n=40, rate=4.0):
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    prompts = rng.integers(1_000, 300_000, n)
    outs = rng.integers(16, 200, n)
    return [pkg.SimRequest(i, float(a), int(p), int(o))
            for i, (a, p, o) in enumerate(zip(arrivals, prompts, outs))]


def _record(reqs):
    return {r.req_id: (r.finish_time, r.failed, dict(r.spans)) for r in reqs}


@pytest.mark.parametrize("striped", [True, False])
@pytest.mark.parametrize("policy", ["infinite", "vllm-multi", "vllm-single"])
def test_simulator_equals_jax_given_v5e(policy, striped):
    jreqs, preqs = _requests(jsim), _requests(psim)
    want = jsim.make_policy_cluster(jax_get_config(ARCH), policy, 16, 4,
                                    striped=striped).run(jreqs,
                                                         horizon=500.0)
    sim = psim.make_policy_cluster(get_config(ARCH), policy, 16, 4,
                                   striped=striped, hw=_v5e())
    hosted = []
    host = sim._host
    sim._host = lambda req, donor, tok: (hosted.append(tok),
                                         host(req, donor, tok))
    got = sim.run(preqs, horizon=500.0)
    assert got == want
    assert _record(preqs) == _record(jreqs)
    assert got["finished"] + got["failed"] == len(preqs)
    # The drawn traffic spills over creditors under the pooled policy.
    assert bool(hosted) == (policy == "infinite")


def test_simulator_serves_the_oversized_request_in_both_packages():
    """A request too big for ONE instance finishes under "infinite"
    (pooled) and fails under "vllm-multi": in both packages given v5e's
    constants, and in the port on the H100's."""
    v5e = _v5e()
    cap = JaxPerf(jax_get_config(ARCH), chips=2).kv_tokens_capacity()
    assert cap == psim.InstancePerfModel(get_config(ARCH), hw=v5e,
                                         chips=2).kv_tokens_capacity()
    h100_cap = psim.InstancePerfModel(get_config(ARCH),
                                      chips=2).kv_tokens_capacity()
    runs = [(jsim, jax_get_config(ARCH), {}, cap),
            (psim, get_config(ARCH), {"hw": v5e}, cap),
            (psim, get_config(ARCH), {"hw": H100}, h100_cap)]
    for pkg, cfg, kw, c in runs:
        out = {policy: pkg.make_policy_cluster(cfg, policy, 8, 2, **kw).run(
            [pkg.SimRequest(0, 0.0, int(c * 1.5), 32)], horizon=300.0)
            for policy in ("infinite", "vllm-multi")}
        assert out["infinite"]["finished"] == 1
        assert out["vllm-multi"]["failed"] == 1
