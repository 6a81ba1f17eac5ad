"""A sampling request handed off mid-decode continues its generator
stream — the port alone (no JAX here, so the ``cuda`` test runs on the
card's machine): the lane's ``torch.Generator`` state rides the handoff
record (``get_state()``), the destination installs it into the lane's
generator without drawing a fresh seed, and the migrated request's
tokens and logprobs equal the same request, same seed, served
unmigrated. The control — a freshly seeded generator installed instead
— parts the stream. On the CPU the CPU generator's Mersenne state
moves; on the card (``cuda``) the CUDA generator's seed and Philox
offset.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare_torch.workloads import serving  # noqa: E402
from tpushare_torch.workloads.models import transformer  # noqa: E402

# the reference fleet tests' engine shape, in f32, at head_dim 64 (the
# paged kernel's width on the card)
CFG = transformer.TransformerConfig(vocab=128, d_model=128, n_heads=2,
                                    n_layers=2, d_ff=128, max_seq=256,
                                    dtype=torch.float32)
PAGED_KW = dict(n_lanes=3, max_seq=96, n_pages=40, page_size=8,
                prompt_buckets=(8, 32), chunk=4)


@pytest.fixture(autouse=True)
def _one_thread_and_clean_provider():
    from tpushare_torch.workloads.telemetry import set_snapshot_provider
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    set_snapshot_provider(None)


def migrate_sampler(device, reseed=False, steps_before=1):
    """Serve a temperature-0.8 request on one engine, or admit it,
    decode ``steps_before`` chunks, then move it to an engine of another
    seed; ``reseed`` (the control) installs a freshly seeded generator
    instead of the carried state. The weights are the port's own
    (seeded ``init_params`` on ``device``): no reference is needed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(gen, CFG, device)

    def eng(seed):
        return serving.PagedServingEngine(params, CFG, seed=seed,
                                          **PAGED_KW)

    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 128, 9)]
    stay = eng(7)
    q_stay = serving.Request(prompt=list(prompt), max_new=16,
                             temperature=0.8)
    stay.submit(q_stay)
    stay.run()
    src = eng(7)
    q = serving.Request(prompt=list(prompt), max_new=16, temperature=0.8)
    src.submit(q)
    src._admit_waiting()
    for _ in range(steps_before):
        src.step()
    lane = next(iter(src.running))
    record = src.extract_request(lane)
    assert record["generator"] is not None
    if reseed:
        fresh = torch.Generator(device=device)
        fresh.manual_seed(12345)
        record = {**record, "generator": fresh.get_state()}
    dst = eng(99)
    admitted_before = dst._admitted
    assert dst.install_request(record) is not None
    assert dst._admitted == admitted_before     # no fresh seed drawn
    src.detach_request(lane)
    dst.run()
    return q_stay, q


@pytest.mark.parametrize("steps_before", [0, 1])
def test_sampled_handoff_continues_generator_stream(steps_before):
    stay, moved = migrate_sampler("cpu", steps_before=steps_before)
    assert moved.status == "completed"
    assert moved.output == stay.output
    assert moved.logprobs == pytest.approx(stay.logprobs)
    # the control: a reseeded generator parts the stream
    stay, moved = migrate_sampler("cpu", reseed=True,
                                  steps_before=steps_before)
    assert moved.output != stay.output


@pytest.mark.cuda
def test_sampled_handoff_continues_cuda_generator_stream():
    """The card's generators (seed + Philox offset) move as their
    ``get_state()`` bytes: a sampler migrated mid-decode continues its
    stream; the reseeded control parts it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA generators")
    stay, moved = migrate_sampler("cuda", steps_before=1)
    assert moved.output == stay.output
    stay, moved = migrate_sampler("cuda", reseed=True, steps_before=1)
    assert moved.output != stay.output
