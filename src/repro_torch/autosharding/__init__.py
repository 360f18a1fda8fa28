"""The autosharding advisor (``advisor``): the paper's analytical model and
GP/PI engine applied to the parallel layout of an LM step."""
