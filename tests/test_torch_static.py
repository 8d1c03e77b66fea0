"""The port's ``StaticBackend`` (``EngineConfig(backend="static")``)
against the JAX package's on the CPU: olmo_1b and recurrentgemma_2b
smoke, ragged prompts, more requests than slots (several lockstep
batches), greedy and seeded rows, a stop token that retires rows early.
Tokens and the backend's ``stats()`` (steps, batches, mean active slots,
cache utilization, prefill shapes) equal JAX's exactly.

Weights are JAX's init carried over with the weight bridge; prompts come
from numpy with a seed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.launch.engine.static import StaticBackend
from repro_torch.models import weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

GEO = dict(backend="static", num_slots=2, block_size=4, max_len=32)
STATS = ("steps", "batches", "mean_active_slots", "cache_utilization",
         "prefill_compiles")


def _work(rng, vocab):
    """Five ragged prompts (three lockstep batches at two slots),
    alternating greedy and seeded rows of 4-9 new tokens."""
    prompts = [list(map(int, rng.integers(0, vocab, n)))
               for n in (5, 11, 3, 7, 9)]
    sps = [SamplingParams(max_tokens=4 + i) if i % 2 == 0 else
           SamplingParams(max_tokens=4 + i, temperature=0.8, top_k=12,
                          top_p=0.9, seed=40 + i)
           for i in range(len(prompts))]
    return prompts, sps


@pytest.mark.parametrize("arch", ["olmo_1b", "recurrentgemma_2b"])
def test_static_matches_jax_static(rng, arch):
    """The same requests through the JAX Engine and the port's, both on
    the static backend, first without and then with a stop token taken
    from the run's own output (so rows retire mid-batch while the rest
    of their batch decodes on)."""
    jm = JModel(jax_config(arch).smoke())
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(arch).smoke()
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    tm = Model(tcfg, device="cpu")
    prompts, sps = _work(rng, tcfg.vocab_size)
    jsps = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]

    def both(eos):
        jeng = JEngine(jm, jparams, JEngineConfig(eos_id=eos, **GEO))
        want = jeng.generate(prompts, jsps)
        eng = Engine(tm, tparams, EngineConfig(eos_id=eos, **GEO),
                     device="cpu")
        assert isinstance(eng.backend, StaticBackend)
        got = eng.generate(prompts, sps)
        assert got == want
        jst, st = jeng.stats(), eng.stats()
        for k in STATS:
            assert st[k] == jst[k], k
        assert st["batches"] == 3
        assert not eng.has_work and len(eng.finished) == len(prompts)
        return want, [h.finish_reason for h in eng.finished]

    want, reasons = both(-1)
    assert set(reasons) == {"length"}
    _, reasons = both(want[1][1])         # a token row 1 emits second
    assert "stop" in reasons and "length" in reasons
