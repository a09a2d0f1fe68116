"""Heads of the port (:mod:`.heads`): CE, angular margin, GE2E."""
