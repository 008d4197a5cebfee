"""koord-manager's slo-controller: the colocation strategy config and
the node-resource controller's batch/mid overcommit (K19 on a card)."""
