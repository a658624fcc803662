"""What a train cell needs of one model, a module each, found by the
configuration's ``model`` field (``bench.model``): ``params``,
``make_step``, ``batch``, ``train_flops``, ``expert_bound_s`` and
``reference_train``."""
