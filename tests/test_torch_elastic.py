"""Elastic rescale in the port, the twin of ``tests/test_elastic.py``'s
first test (the second is ``test_torch_elastic_shrink.py``, a file of its
own so that the two spread over test workers): a checkpoint of a sharded
train state written on one mesh of gloo CPU ranks restores onto a mesh of
another size, placed by ``tree_shardings``
(``CheckpointManager.restore(shardings=, mesh=)``), and the restored
model's parameter checksum and loss on a fixed batch hold the reference's
parity bounds (1e-5 and 1e-4, relative).
"""

from _torch_dist import assert_parity, elastic_runner


def test_checkpoint_restores_on_different_mesh(tmp_path):
    run = elastic_runner(str(tmp_path / "ck"))
    saved = run(8, "4x2", "save")
    restored = run(4, "2x2", "restore")  # "half the cluster died"
    assert_parity(saved, restored, "8 -> 4 ranks")
    grown = run(8, "4x2", "restore")     # scale back up
    assert_parity(saved, grown, "4 -> 8 ranks")
