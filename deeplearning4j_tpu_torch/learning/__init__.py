from .updaters import Adam, AdamW, Nesterovs, Sgd
