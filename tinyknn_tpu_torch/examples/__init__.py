"""The user examples, ported from the JAX package's ``examples/``.

Each module is the counterpart of one JAX script, runs as
``python -m tinyknn_tpu_torch.examples.<name>``, takes that script's
arguments under the same names and defaults plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain torch versions of the
kernels), prints what the script prints, and returns its numbers from
``main(argv=None)``:

- ``example``: the reference's full-scan demo (FastPQ estimate, true-NN
  rank, QPS);
- ``ivf_example``: an IVF recall/QPS sweep over n_probes;
- ``multiprobes``: the build_probes x n_probes recall grid;
- ``flat_baseline``: the exact ``Flat`` index's QPS;
- ``bench``: the build_probes x n_probes sweep with its truth and index
  caches and the QPS-recall AUC;
- ``serving_pipeline``: ``query_stream(device_out=True)`` into a second
  stage on the device, against a host hop;
- ``latency``: gather against bucket mode per call, and the stream's
  marginal batch time;
- ``stream_guidance``, ``p1_frontier``, ``exact_frontier``: tuning
  sweeps over a saved index;
- ``coverage_ceiling``: the probe-coverage recall ceiling of an archive
  (NumPy only);
- ``sift_convert``: SIFT ``.fvecs`` to ``.npy``.

Ids come back to the host with ``.cpu().numpy()``; times are host clock
after ``utils.block``.
"""
