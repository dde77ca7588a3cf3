"""The PPO iterations' share of the card's dense bf16 tensor peak: the
actor-critic's operations over the traced window -- the program's
``model_rows`` (rows through the forward in collect) times a forward's
operations a row, plus its ``update_rows`` (rows through forward and
backward in the update, each epoch again) times a training row's -- over
the window's seconds, over the peak.

The peak is read from the card: 4,096 dense bf16 operations a clock an SM
(a multiply-add is two) x SMs x the maximum SM clock, 1,070e12/s on an
H100 SXM at 1,980 MHz (NVIDIA states 989.4e12 at 1,830 MHz).  The
operations a row are counted here from the configuration's widths
(``rec.roofline["model"]``), as ``chip_smoke.update_flop_per_row`` counts
them: two per multiply-add of every convolution (at each output position)
and dense layer forward, twice that backward (the input and the weight
gradient) less the first layer's input gradient, which nothing needs."""

from ..program_trace import roots

BF16_OPS_PER_CLOCK_PER_SM = 4096


def layer_macs(model: dict) -> list:
    """Multiply-adds a row of each layer, in order: the convolutions, the
    dense layer, the policy and the value head."""
    positions = model["window"] ** 2
    k2 = model["kernel"] ** 2
    ins = [model["features"]] + [model["channels"]] * (model["conv_layers"] - 1)
    convs = [c * model["channels"] * k2 * positions for c in ins]
    hidden = model["hidden"]
    return convs + [positions * model["channels"] * hidden,
                    hidden * model["moves"], hidden]


def ops_per_row(model: dict):
    """``(forward, forward and backward)`` operations of one row."""
    macs = layer_macs(model)
    return 2 * sum(macs), 6 * sum(macs) - 2 * macs[0]


def peak(rates) -> float:
    return BF16_OPS_PER_CLOCK_PER_SM * rates.sms * rates.clock_mhz * 1e6


def read(rec, name):
    steps = roots(rec, "ppo.step")
    model = (rec.roofline or {}).get("model")
    if not steps or model is None or rec.rates is None:
        return None
    fwd, train = ops_per_row(model)
    ops = sum(r.counts.get("model_rows", 0) * fwd
              + r.counts.get("update_rows", 0) * train for r, _ in steps)
    return 100.0 * ops / rec.window_s / peak(rec.rates)
