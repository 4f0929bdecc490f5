"""The port's numpy data pipeline draws exactly the reference's arrays."""
import numpy as np
import pytest

from repro.data import federated as jfed
from repro.data.partition import dirichlet_partition as j_partition
from repro.data.synthetic import SyntheticImageTask as JImageTask
from repro_torch.data import federated as tfed
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import SyntheticImageTask
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("kw", [dict(n_clients=10, seed=0),
                                dict(n_clients=12, alpha=0.1, seed=3),
                                dict(n_clients=6, alpha=float("inf"), seed=1,
                                     img=8, n_classes=4)],
                         ids=["default", "skewed", "iid"])
def test_synthetic_image_task_is_exact(kw):
    want, got = JImageTask(**kw).build(), SyntheticImageTask(**kw).build()
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(want[3]) == len(got[3])
    for a, b in zip(want[3], got[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha", [0.05, 0.5, float("inf")])
def test_dirichlet_partition_is_exact(alpha):
    labels = np.random.default_rng(0).integers(0, 7, size=300)
    want = j_partition(labels, 20, alpha, np.random.default_rng(5))
    got = dirichlet_partition(labels, 20, alpha, np.random.default_rng(5))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_federated_dataset_and_cohort_draws_are_exact():
    # from_arrays shuffles the index arrays in place: one copy each
    x, y, _, idx = JImageTask(n_clients=10, seed=2).build()
    want = jfed.FederatedDataset.from_arrays(x, y, [i.copy() for i in idx],
                                             seed=2)
    got = tfed.FederatedDataset.from_arrays(x, y, [i.copy() for i in idx],
                                            seed=2)
    assert want.n_clients == got.n_clients
    for a, b in zip(want.clients, got.clients):
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(want.test_arrays()[1], got.test_arrays()[1])
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(4):
        cj = jfed.sample_cohort(10, 0.3, rj, min_cohort=2, max_cohort=3)
        ct = tfed.sample_cohort(10, 0.3, rt, min_cohort=2, max_cohort=3)
        np.testing.assert_array_equal(cj, ct)
        for c in cj:
            bj = want.clients[c].sample_batch(rj, 8)
            bt = got.clients[c].sample_batch(rt, 8)
            np.testing.assert_array_equal(bj[0], bt[0])
            np.testing.assert_array_equal(bj[1], bt[1])


def test_image_task_arrays_are_exact():
    from repro.api.tasks import build_task as j_build
    from repro_torch.api.tasks import build_task
    _, jf, jk = j_build("image", 8, 0.5, 4, 4, 2)
    task, tf, tk = build_task("image", 8, 0.5, 4, 4, 2)
    assert jk == tk == "accuracy" and task.name == "femnist_cnn@cut2"
    for a, b in zip(jf.clients, tf.clients):
        np.testing.assert_array_equal(a.x_train, b.x_train)
        np.testing.assert_array_equal(a.y_test, b.y_test)
    assert tf.clients[0].x_train.shape[1:] == (28, 28, 1)
