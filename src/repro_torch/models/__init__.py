"""The port's LM substrate: configs (``config``), layers (``layers``), the
blocks and layer stack (``transformer``) and ``build_model`` (``model``),
serving every family of the registry: ``dense``, ``moe`` (with MLA),
``ssm``, ``hybrid``, ``encdec`` and ``vlm`` (with M-RoPE)."""
