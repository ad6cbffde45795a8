"""The shapes and configs that ``tests/test_torch_placement.py`` and its
reference process (``_torch_placement_reference.py``) share: the
reference's two sharded-render tests' slots, counts and scene groups,
and the serve run's trace and configs. The scenes and poses themselves
are made once, by the reference process from the reference's seeded
generator (``SCENES``), and handed to the test in an npz before that
process renders."""
SIZE = 48
CAM_LOOK = ((0.0, -0.3, -2.0), (0.0, 0.0, 6.0))
B, F = 8, 4
COUNTS = (4, 3, 4, 0, 2, 4, 1, 4)
STREAM_CFG = dict(window=3, rerender_capacity=4, capacity=256)
MULTI_BUCKETS = (256, 512)
# contiguous scene groups of B/D = 1..2 slots
SLOT_SCENE = (0, 0, 1, 1, 2, 2, 3, 3)
FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
# name -> (PRNG key, Gaussians, clutter) of a ``structured_scene``
SCENES = {"single": (7, 300, 0.5),
          **{f"multi{i}": (50 + i, 260 + 20 * i, 0.4 + 0.1 * i)
             for i in range(4)}}

SERVE_DEVICES = 4
SERVE_TRACE = [[0, 1, 1], [1], [], [0, 0], [1]]
SERVE_TRAFFIC = dict(min_frames=3, max_frames=6, seed=3, scenes=2)
SERVE_CFG = dict(capacity=128, chunk=32, window=4)
# the server serves "multi0" and "multi1" (one bucket of 512); one R
SERVE_SCFG = dict(slots=8, chunk=2, r_buckets=(8,), scene_buckets=(512,),
                  collect_frames=True)
