"""Training side of the port.  So far its inference half: the ``.npz``
checkpoint reader and the :class:`~.engine.Engine`'s ``infer`` methods;
the training steps come with the training slice (``ROADMAP.md`` A.9)."""
