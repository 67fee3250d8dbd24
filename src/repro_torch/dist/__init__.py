"""dist of the PyTorch port: serving and training on a (data, model) mesh
over ``torch.distributed`` (port of ``repro/dist``).

  * ``backend``      — the process prologue: the backend rule (NCCL with a
                       card a rank, gloo where ranks share a card or run on
                       the CPU), ``init``, ``spawn``, ``summary``.
  * ``context``      — ``MeshContext`` over a ``DeviceMesh`` and the port's
                       only collective layer, every call tallied; the
                       differentiable Megatron pair (``reduce_from_model``,
                       ``copy_to_model``).
  * ``sharding``     — the reference's path-based partition rules, the
                       shard cut (``shard_model``) and its inverse
                       (``unshard``), each gradient's kind on the model
                       axis (``leaf_kind``), the moments' specs.
  * ``sampling``     — the samplers, off the mesh and shard-local over
                       vocab-sharded logits.
  * ``pipeline_par`` — GPipe over a stage axis (``pipeline_apply``).

The sharded train state is ``train/state.py``'s; the mesh step
``train/step.py``'s.
"""
