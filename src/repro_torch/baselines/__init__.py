"""The paper's comparison baselines: B-BFS (Table 7's index-free search),
IP-lite (the dynamic label of Figs 4-5) and the DAG-maintenance proxy
(DAGGER's cost)."""
