"""Model families beside SpeedyFeed: the LM family (``lm``)."""
