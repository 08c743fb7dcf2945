"""Recommendation models of the port: MIND (``models.recsys.mind``)."""
