"""h2d_mb_per_batch.score: MB (1e6 bytes) the program's ``DeviceFeeder``
shipped to the card a batch in the window (its ``bytes_fed`` counter;
``train/pipeline.py``). Moves ``score_nodes_per_s``.
"""

PHASE = "score"


def read(r):
    if r.phase != PHASE or not r.steps:
        return None
    return r.h2d_bytes / r.steps / 1e6
