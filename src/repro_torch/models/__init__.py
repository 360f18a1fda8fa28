"""The port's LM substrate: configs (``config``), layers (``layers``), the
block stack (``transformer``) and ``build_model`` (``model``).  Only the
``hybrid`` (Hymba) family's serving path is ported so far."""
