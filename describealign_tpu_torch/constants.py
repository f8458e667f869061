"""Constants the port shares with the reference's tunables
(describealign.py:29-31), copied from describealign_tpu/constants.py."""

TIMESTEPS_PER_SECOND = 10          # factors must be subset of (2, 3, 5, 7)
