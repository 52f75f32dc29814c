"""umgap_tpu_torch — the UMGAP analysis pipeline in PyTorch on an NVIDIA GPU.

A port of ``umgap_tpu`` (the JAX package, kept beside it as the
reference) to PyTorch with CUDA C++ kernels written for Hopper
(``sm_90a``). The package imports ``torch`` and numpy only; it keeps its
own copies of the host code it needs (taxonomy, encodings, index format,
FASTA/FASTQ readers), so it runs on a machine without JAX.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, or ``--device cpu`` on the command line): there is no
automatic fall back to the CPU. On the CPU every kernel wrapper runs its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.

Layout (module names mirror ``umgap_tpu``):

- ``ranks`` / ``taxonomy``: the NCBI taxonomy as dense arrays.
- ``ops``: encodings, reads to k-mer keys (kernel K1), the index probe
  (K2), seed-extend (K3).
- ``agg.device``: per-read dedup (K4) and the aggregation tail.
- ``index.table``: the packed k-mer hash table and its ``.npz`` format.
- ``pipeline``: the fused 9-mer presets, ``make_pipeline`` and the
  streaming ``Analyser``; the tryptic presets; the protein pipelines
  behind FragGeneScan++ (``pipeline.proteins``, kernel K1P).
- ``configdir`` / ``fgspp``: data-version discovery under the config dir
  and the FragGeneScan++ subprocess front end.
- ``kernels``: building the CUDA sources in ``csrc/`` and binding them.
- ``convert``: state carried across from arrays of the JAX package.
- ``cli``: ``python -m umgap_tpu_torch analyse``.
"""

__version__ = "0.1.0"
