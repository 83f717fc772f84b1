"""Losses of the train steps: set criterion, Hungarian matcher, LSAP."""
