"""The whole forward's share of the card's TF32 peak: useful FLOPs an
image (``yardstick.forward_flops``) x the window's images a second over
495 TFLOP/s."""
from escoin_bench import yardstick


def read(run):
    rate = run.e2e.get("images_per_s", 0.0)
    if rate <= 0 or run.flops_per_image <= 0:
        return None
    return 100.0 * rate * run.flops_per_image / yardstick.PEAK_FLOPS
