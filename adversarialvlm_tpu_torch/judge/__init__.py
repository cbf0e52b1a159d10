"""The safety judge: the FSM-constrained JSON decode (fsm.py), the SafetyChecker
(safety_checker.py) and the tiny pretrained judge (tiny.py). Counterpart of
adversarialvlm_tpu/judge/."""
