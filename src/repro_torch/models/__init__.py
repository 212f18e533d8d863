"""Model families beside SpeedyFeed: the LM family (``lm``) and the recsys
family (``recsys``)."""
