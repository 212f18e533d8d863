"""Model families beside SpeedyFeed: the LM family (``lm``), the recsys
family (``recsys``) and the news baselines (``news``: NPA, NAML, LSTUR,
NRMS)."""
from . import news
from .news import NewsBaselineConfig

__all__ = ["news", "NewsBaselineConfig"]
