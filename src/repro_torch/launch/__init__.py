"""Launchers of the port: serve, train, the mesh shapes and the dry-run
plans (``specs``, ``dryrun``, ``roofline``).

The reference's ``hlo_analysis.py`` has no port: it parses the HLO text of
an XLA-compiled program (trip-count-corrected FLOPs and collective bytes),
and the port compiles no program to parse — its kernels are hand-written
CUDA launched through ctypes, invisible to any graph.  The port counts
what it runs instead: ``kernels.ops.launch_counts`` (every kernel's
launches, read by chip_smoke's path checks) and ``dist.tp.COLLECTIVES``
(every serving-TP collective by kind, read by ``dryrun.run_tp_serve_cell``
and the TP tests).  Importing ``dryrun`` changes no process-wide setting:
its plans live on the meta device.
"""
