"""Training losses by name: each module gives the program's loss
(``program()``, through the port's loss registry) and its plain reference
(``reference(labels, logits)``, ``cardbench/reference/ranking.py``)."""
