"""dist of the PyTorch port: serving on a (data, model) mesh over
``torch.distributed`` (port of ``repro/dist``).

  * ``backend``  — the process prologue: the backend rule (NCCL with a
                   card a rank, gloo where ranks share a card or run on
                   the CPU), ``init``, ``spawn``, ``summary``.
  * ``context``  — ``MeshContext`` over a ``DeviceMesh`` and the port's
                   only collective layer, every call tallied.
  * ``sharding`` — the reference's path-based partition rules, the shard
                   cut (``shard_model``) and its inverse (``unshard``).
  * ``sampling`` — the samplers, off the mesh and shard-local over
                   vocab-sharded logits.

Training on a mesh (``pipeline_par``, the sharded train state) is a later
slice.
"""
