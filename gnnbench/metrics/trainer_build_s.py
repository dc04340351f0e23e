"""trainer_build_s: host seconds of the program's ``Trainer`` constructor
(``train/loop.py``: the sampler's calibration of the phase's buckets,
the feature table to the card, the model and optimizer), on the
harness's clock. Moves ``setup_s``.
"""

def read(r):
    return getattr(r, "trainer_build_s", None)
